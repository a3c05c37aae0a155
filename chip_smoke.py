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
     prunes. The trackers' greedy matching kernel against its plain loop
     pair for pair on a tracker round's masked 64 x 20 cost, the loop
     timed outside a graph, as it reads back every round. Beside them, an
     empty kernel (`rt3d_noop`) timed the same way:
     the launch floor every kernel's time is read against. Then the
     kernels over the JAX package's whole domain (`check_domain`): K3 on
     the same slots at k 33, 48, 64, 100, 256 and 2048 (= cap) and K5 on
     a 4096-row cloud at k 33, 64 and 4096 (the radix-select kernel,
     counted as a large-k launch), K1 and K2 on the 720 x 1280 grids at
     windows (5, 6), (4, 7), (8, 12) and (16, 3) (the wide kernel), each
     bit for bit against its plain version and timed beside it, its bound
     and (K3/K5) `cdist` + `topk` at the same k;
  4. the main path: `build_pipeline` on the default config (two HD720
     cameras, yolo11x-seg with the committed weights, ByteTrack, 5 mm
     voxels) stepping 8 synthetic frames, every kernel's launch counter
     checked per step (the greedy kernel's as the step's path ran it: its
     solves a step, which the track stage's graph replays); then (4b) K3
     on the step's own fused slots of the last frame (bit for bit, timed
     beside `cdist` + `topk`), and (4c) K1,
     K2 and K4 on the step's own inputs of the last frame, rebuilt by the
     pipeline's stages (`step_kernel_inputs`: they must give the step's
     object voxels and keep mask), each checked, timed and bounded for
     those inputs, with K1's and K2's sentinel shares, the share of K1's
     tiles that hold a live key and of its live keys that are duplicates,
     and the share of K4's valid pairs its box tests keep, and the greedy
     kernel on the last frame's own solves, each equal to the plain loop;
  5. the same frames with every kernel swapped for its plain version
     (`build_pipeline(plain_kernels=True)`), held against phase 4;
  4d. the `2cam` preset with ``sor_nb_neighbors=50`` (`2cam_k50`), 6
     frames: K3 through its large-k kernel once a step, the plain run
     equal bit for bit (every output, `same_outputs` on the last frame),
     its steady device ms beside phase 4's;
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
  11. the int8 backbone (`2cam_int8`: yolo11x-seg with stages 1-15 int8,
     preprocess and mask resize in float32): its live calibration on 4
     frames, timed; 8 HD720 frames with counters checked per step and a
     plain run compared, as in phases 4-5; for a stage-1 conv, the conv of
     K = 6912 and a depthwise `pe` conv, the card's int32 sums on the
     first frame's inputs equal to the CPU's int64 sums of the same int8
     tensors; detect timed int8 against bf16 on the same frames; and
     `python -m rt3d_torch.apps.two_cam --quantize` in-process on the
     first 6 frames of phase 8b's recording (stale x sidecar: it must
     recalibrate); (11b) `python -m rt3d_torch.apps.calibrate_quant` on
     the x weights into a temporary sidecar (the committed one is left as
     it is), which `load_act_scales` must accept against the weights;
     `2cam_int8` on its scales for 6 frames with no live calibration,
     bit for bit its plain run; `python -m rt3d_torch.apps.eval_quant`
     with it (6 frames: fp and int8 recall, mean IoU, precision side by
     side); and `tests/test_quant.py`'s bar on frame 11 of the seed-4242
     scene (the same detection count, every int8 box within 2 px and
     score within 0.05 of fp);
  9. every preset (the seven of phases 4-11) in float32 (TF32 off) over the
     frames of its JAX golden (`tests/golden_torch/`, from
     `tools/make_torch_golden.py`), held against it within the bands of
     `rt3d_torch/golden.py` (the tracker presets with their embeddings,
     GMC warps and ByteTrack IDs; 2cam_int8 quantized against the golden's
     scales, with the card's own float32 calibration held against them);
     then its usual bf16 step over the same frames, whose differences are
     printed only;
  12. the training path (`rt3d_torch.train`, `rt3d_torch.apps.train_synth`):
     (a) the float32 step (TF32 off) of yolo11x-seg with the committed
     weights on the `train_x` golden's batch (two HD720 frames rebuilt from
     its seed, their hashes checked), then one update of the trainer's
     optimizer, held within the golden's bands (`rt3d_torch.golden`:
     loss and parts, the global and every leaf's gradient norm, the head's
     last biases' gradients, every leaf's update norm); (b) the trainer
     called in-process: the x model at batch 8, resumed from the committed
     weights, 30 bf16 steps on 4 scenes x 2 frames x 2 cameras of HD720
     `mix` data, every loss finite, device ms a step (CUDA events, median
     of the steady steps), images/s, peak memory, the render and staging
     seconds, the kernel time of a step's forward, backward and optimizer
     and its top device ops (`profile_op_times`), and its saved
     `.npz` driving a frame of the 2cam preset; (c) the port's
     `evaluate_weights` on the committed x weights at the manifest's eval
     settings (10 hard frames, its seed, conf 0.25), held to the x bars of
     `tests/test_detection_loop.py` (copied here), the easy family beside
     it;
  13. the multi-device paths: (a) a world-1 NCCL process group, started
     in-process on an in-memory store (no port, no other process) and
     destroyed on every way out; (b) `rt3d_torch.parallel.make_sharded_step`
     over 6 HD720 frames of `2cam` (x model, committed weights) and (c)
     over 2 frames of `stretch_4cam_1mm` (its replicated accumulator
     carried), each frame's outputs and state bit for bit equal to the
     preset's own `Pipeline.step` on the same frames, each kernel's
     launches per step as that step's (K1-K4 on 2cam, K4 alone on the
     stretch), the two steps' device ms per frame side by side (they take
     turns going first); (d) `make_train_step(mesh=make_mesh({"dp": 1,
     "fsdp": 1}))` (FSDP2) on phase 12a's `train_x` batch in float32 from
     the committed weights: one step within the golden's bands, its loss,
     update norms and largest parameter difference from phase 12a's step,
     then its device ms beside the unsharded `make_train_step`'s; (e)
     `python -m rt3d_torch.apps.track_only` called in-process on 6
     synthetic HD720 frames of one camera with ``--live`` into a temporary
     spool (its `status.json` and its frame checked), then `viewer --once`
     on that spool, headless; no thread that the process group started,
     native ones included (`/proc/self/task`: PyTorch's NCCL watchdog and
     heartbeat monitor, NCCL's own; NCCL's RAS service is off), outlives
     its destruction, and no Python thread is left behind.

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
import tempfile
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


def window_ops(torch, kg, wg=None, window=(4, 6)):
    """Integer operations the window's data needs: K1 one compare (its OR
    folds into the compare's predicate) for each of the window's offsets
    (58 at the step's 4 x 6) of each live key; K2 the compares of each pixel
    that has a non-zero word in its window (every other output is 0
    whatever the keys), plus one OR for each same-key neighbour with a
    non-zero word."""
    from rt3d_torch.geometry import ops

    offsets = list(ops._window_offsets(*window))
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
    # the large-k cases' cloud draws from its own generator, so `gen`'s later
    # draws (phase 7) stay those of earlier runs
    gen = torch.Generator(device=dev).manual_seed(4096)
    c5c, c5cv = cloud(4096)
    # a tracker round: 1 - IoU of 64 track slots and 20 detection slots,
    # rows and columns outside the round at 1e6
    from rt3d_torch.models.postprocess import box_iou_matrix

    xy = torch.rand((84, 2), device=dev, generator=gen) * 400
    boxes = torch.cat([xy, xy + 40 + torch.rand((84, 2), device=dev, generator=gen) * 80], 1)
    live = torch.rand(84, device=dev, generator=gen) < 0.7
    cost = torch.where(live[:64, None] & live[None, 64:],
                       1.0 - box_iou_matrix(boxes[:64], boxes[64:]), 1e6)
    return dict(k1=k1, k2=k2, w2=w2, pts=pts, valid=valid, q=q, r=r.contiguous(), rv=rv,
                c5=c5, c5v=c5v, c5b=c5b, c5bv=c5bv, c5c=c5c, c5cv=c5cv, cost=cost)


def check_kernels(torch, gen):
    from rt3d_torch import kernels
    from rt3d_torch.geometry import ops, sor, subtract
    from rt3d_torch.tracking import assignment

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
    # the greedy matcher: pair for pair against its plain loop on a
    # tracker round's masked 1 - IoU cost at the main path's 64 x 20; timed
    # beside the plain loop, which reads a flag back every round
    cost, thresh = x["cost"], 0.8
    got = assignment.solve_matching_greedy(cost, thresh)
    check(all(torch.equal(a, b) for a, b in zip(
        got, assignment.solve_matching_greedy_plain(cost, thresh))),
        "greedy_match differs from its plain loop")
    nr, nc = cost.shape
    rows.append(dict(
        name="greedy_match", source="rt3d_torch/csrc/greedy_match.cu",
        replaces=None, max_abs_err=0, pairs=int((got[0] >= 0).sum()),
        ms=time_ms(torch, lambda: assignment.solve_matching_greedy(cost, thresh)),
        plain_ms=time_ms(torch, lambda: assignment.solve_matching_greedy_plain(cost, thresh),
                         graph=False),
        library_ms=None,
        # one round reads the matrix once and compares each entry twice
        bound=bound(4 * nr * nc + 8 * (nr + nc), 2 * nr * nc)))
    check_domain(torch, x, {r["name"]: r for r in rows})
    kernels.reset_launches()
    return rows


# the cases of the kernels' whole domain: K3 on the worst-case slots and K5
# on a 4096-row cloud above the register path's k = 32 (up to k = rows), K1
# and K2 on the 720 x 1280 grids at windows wider than 4 x 6
K3_LARGE_K = (33, 48, 64, 100, 256, 2048)
K5_LARGE_K = (33, 64, 4096)
WIDE_WINDOWS = ((5, 6), (4, 7), (8, 12), (16, 3))


def knn_library(torch, pts, k):
    """`cdist` + `topk`: the k-nearest mean in two library calls."""
    return torch.topk(torch.cdist(pts, pts), k, dim=-1, largest=False).values.sum(-1) / (k - 1)


def check_domain(torch, x, rows):
    """Phase 3's cases over the JAX package's whole domain, each bit for bit
    against its plain version (K3/K5 `mean` and `saturated`, K1/K2 outputs),
    launched as a large-k or wide-window call, and timed beside its plain
    version, its bound and (K3/K5) `cdist` + `topk` at the same k. Adds a
    `large_k` list to the K3 and K5 rows and a `wide_window` list to K1's
    and K2's."""
    from rt3d_torch import kernels
    from rt3d_torch.geometry import ops, sor

    def sor_case(fn, pts, valid, k, name, what):
        before = dict(kernels.LAUNCHES)
        mean, sat = fn(pts, valid, k)
        check(kernels.LAUNCHES[f"{name}_large_k"] == before[f"{name}_large_k"] + 1,
              f"{what} at k = {k} did not launch the large-k kernel")
        pmean, psat = fn(pts, valid, k, plain=True)
        check(torch.equal(mean, pmean) and torch.equal(sat, psat),
              f"{what} at k = {k} differs from its plain version")
        n = valid.sum(-1).long()
        b = bound(pts.shape[:-1].numel() * (12 + 1 + 4 + 1), int((n ** 2).sum()) * 10)
        return dict(k=k, max_abs_err=float((mean - pmean).abs().max()),
                    ms=time_ms(torch, lambda: fn(pts, valid, k)),
                    plain_ms=time_ms(torch, lambda: fn(pts, valid, k, plain=True)),
                    library_ms=time_ms(torch, lambda: knn_library(torch, pts, k)), **b)

    rows["sor_knn_slots"]["large_k"] = [
        sor_case(sor.sor_knn_mean_slots, x["pts"], x["valid"], k, "sor_knn_slots", "K3")
        for k in K3_LARGE_K]
    rows["sor_knn"]["large_k"] = [
        sor_case(sor.sor_knn_mean, x["c5c"], x["c5cv"], k, "sor_knn", "K5 on 4096 rows")
        for k in K5_LARGE_K]
    kg, wg = x["k2"], x["w2"]
    hw = kg.numel()
    for name, args, nbytes, words in (("window_dedupe", (kg,), 8 * hw, None),
                                      ("window_prev_or", (kg, wg), 12 * hw, wg)):
        fn = getattr(ops, name)
        cases = []
        for win in WIDE_WINDOWS:
            before = kernels.LAUNCHES[name]
            got = fn(*args, *win)
            check(kernels.LAUNCHES[name] == before + 1, f"{name} at {win} did not launch")
            ref = fn(*args, *win, plain=True)
            check(torch.equal(got, ref), f"{name} at window {win} differs from its plain version")
            cases.append(dict(
                window=list(win), max_abs_err=int((got.long() - ref.long()).abs().max()),
                ms=time_ms(torch, lambda: fn(*args, *win)),
                plain_ms=time_ms(torch, lambda: fn(*args, *win, plain=True)), library_ms=None,
                **bound(nbytes, int_ops=window_ops(torch, kg, words, win))))
        rows[name]["wide_window"] = cases


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
            masks = pipe.masks(pipe.mask_model.context(rgb, protos), det)[0]
            objs, _ = pipe.object_clouds(depth, masks, det, out.track_ids, calib)
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
    against its plain version, timed beside its bound for those inputs; the
    greedy kernel on the step's own solves (`time_step_greedy`). The
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
    res["greedy_match"] = time_step_greedy(torch, run)
    return res


def time_step_greedy(torch, run):
    """The greedy kernel on the last frame's own cost matrices: the track
    stage stepped again from the state the last frame was stepped from,
    eagerly (autograd on), hands over every solve's matrix; each is held
    against the plain loop pair for pair, and the first is timed beside
    it."""
    from rt3d_torch.tracking import assignment

    pipe, prev = run["pipe"], run["prev"]
    with torch.enable_grad(), recording(assignment, "solve_matching_greedy") as calls:
        pipe.track(prev, run["last"].detections)
    cams = len(prev.trackers)
    check(len(calls) == GREEDY_SOLVES[pipe.cfg.tracker.tracker_type] * cams,
          f"the track stage made {len(calls)} greedy solves for {cams} cameras")
    pairs = 0
    for cost, thresh in calls:
        got = assignment.solve_matching_greedy(cost, thresh)
        check(all(torch.equal(a, b) for a, b in zip(
            got, assignment.solve_matching_greedy_plain(cost, thresh))),
            f"greedy_match differs from its plain loop on a {tuple(cost.shape)} solve of the step")
        pairs += int((got[0] >= 0).sum())
    cost, thresh = calls[0]
    return dict(solves=len(calls), shape=list(cost.shape), pairs=pairs,
                ms=time_ms(torch, lambda: assignment.solve_matching_greedy(cost, thresh)),
                plain_ms=time_ms(torch, lambda: assignment.solve_matching_greedy_plain(
                    cost, thresh), graph=False))


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
    v = res["greedy_match"]
    log(f"  greedy_match on {name}'s {v['solves']} solves of the last frame ({v['shape'][0]}x"
        f"{v['shape'][1]}, {v['pairs']} pairs, each equal to the plain loop's): the first "
        f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms")


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
    JAX golden (`rt3d_torch.golden`, bands in its docstring; the tracker
    presets with their embeddings, GMC warps and ByteTrack IDs through a
    `golden.Probe`; 2cam_int8 quantized against the golden's activation
    scales, and the card's own float32 calibration held against those
    scales within `golden.CALIB_RTOL`); then the preset's usual bf16 step
    over the same frames (2cam_int8 calibrated live), whose differences
    from the golden are measured and printed, not checked. Every preset is
    measured before any band is checked."""
    from rt3d_torch import golden
    from rt3d_torch.models import quant
    from rt3d_torch.pipeline.presets import (
        CALIB_FRAMES, PRESETS, preset_config, preset_weights, synthetic_preset,
    )
    from rt3d_torch.pipeline.step import build_pipeline

    res = {}
    for name in PRESETS:
        g = golden.load_golden(name)
        n = int(g["frames"])
        scales = golden.golden_act_scales(g) if PRESETS[name].quantize else None
        res[name] = {}
        for dtype in ("float32", None):  # None: the preset's usual bf16
            gc.collect()
            torch.cuda.empty_cache()
            pipe, src = synthetic_preset(name, n, dtype=dtype,
                                         act_scales=scales if dtype else None)
            probe = golden.Probe(pipe) if "f0_bytetrack_ids" in g else None
            state, calib = pipe.init_state(), pipe.calib()
            outs = []
            for i in range(n):
                pkt = src.get(i)
                state, o = pipe.step(state, torch.from_numpy(pkt.rgb).cuda(),
                                     torch.from_numpy(pkt.depth).cuda(), calib)
                outs.append(o)
            rec = golden.record(outs, float(g["subtraction_threshold"]),
                                pipe.cfg.pipeline.workspace_accumulate,
                                probe.frames if probe else None)
            res[name][dtype or "usual"] = golden.measure(rec, g)
            del pipe, outs, probe
        if scales:
            pipe = build_pipeline(preset_config(name, src, "float32"), weights=preset_weights(name))
            own = quant.collect_act_scales(
                pipe.model, quant.synth_calib_batches(pipe, src, range(CALIB_FRAMES)))
            check(own.keys() == scales.keys(), f"{name}: calibrated convs differ from the golden's")
            res[name]["calib_rel_max"] = max(abs(own[p] - scales[p]) / scales[p] for p in scales)
            del pipe
        log(f"  {name}: {json.dumps(res[name])}")
    for name, r in res.items():
        try:
            golden.check_bands(r["float32"], name)
        except AssertionError as e:
            raise AssertionError(f"{name} float32: {e}") from None
        if "calib_rel_max" in r:
            check(r["calib_rel_max"] <= golden.CALIB_RTOL,
                  f"{name}: float32 calibration {r['calib_rel_max']} from the golden's scales, "
                  f"beyond {golden.CALIB_RTOL}")
    return res


# ---------------------------------------------------------------------------
# Phase 11: the int8 backbone
# ---------------------------------------------------------------------------

# a stage-1 conv, the conv of K = 3 * 3 * 768 = 6912, a depthwise `pe` conv
INT8_CONVS = ("1/conv", "7/conv", "10/m/0/attn/pe/conv")


def calibrate_int8(torch):
    """2cam_int8's live calibration on the card: the preset's bf16
    pipeline, not yet quantized, over frames 0 to CALIB_FRAMES - 1 of its
    source (preprocess and forward with every conv's input reduced),
    timed. Returns (scales, seconds, that bf16 pipeline)."""
    from rt3d_torch.models import quant
    from rt3d_torch.pipeline.presets import (
        CALIB_FRAMES, preset_config, preset_source, preset_weights,
    )
    from rt3d_torch.pipeline.step import build_pipeline

    src = preset_source("2cam_int8", FRAMES)
    pipe = build_pipeline(preset_config("2cam_int8", src), weights=preset_weights("2cam_int8"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    scales = quant.collect_act_scales(pipe.model, quant.synth_calib_batches(
        pipe, src, range(CALIB_FRAMES)))
    return scales, time.perf_counter() - t, pipe


def int64_conv(torch, xq, conv):
    """`conv`'s sum over int8 NCHW `xq`, on the CPU in int64 from the same
    int8 tensors: per tap of the k x k window, the zero-padded, strided
    input times the tap's weights (a matmul over channels, or for a
    depthwise conv a product per channel)."""
    F = torch.nn.functional
    x, w = xq.cpu().long(), conv.weight.cpu().long()
    n, c, h, wd = x.shape
    k, s, p = conv.k, conv.stride, conv.pad
    ho, wo = (h + 2 * p - k) // s + 1, (wd + 2 * p - k) // s + 1
    xp = F.pad(x, (p, p, p, p))
    acc = torch.zeros(n, w.shape[0], ho, wo, dtype=torch.int64)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, :, dy:dy + s * (ho - 1) + 1:s, dx:dx + s * (wo - 1) + 1:s]
            if conv.groups == 1:
                prod = tap.permute(0, 2, 3, 1).reshape(-1, c) @ w[:, :, dy, dx].t()
                acc += prod.reshape(n, ho, wo, -1).permute(0, 3, 1, 2)
            else:
                acc += tap * w[:, 0, dy, dx][None, :, None, None]
    return acc


def check_int8_sums(torch, run):
    """For each conv of `INT8_CONVS`, its input on the step's first frame
    (the step's own preprocess and detect, eager, recorded by a forward
    pre-hook), quantized on the card: the card's int32 sum equals the
    CPU's int64 sum of the same int8 tensors, bit for bit."""
    from rt3d_torch.models.yolo import QConv

    pipe = run["pipe"]
    seen, handles = {}, []
    for path in INT8_CONVS:
        conv = pipe.model.get_submodule(path.replace("/", "."))
        check(isinstance(conv, QConv), f"2cam_int8: {path} is not quantized")
        handles.append(conv.register_forward_pre_hook(
            lambda m, a, path=path: seen.setdefault(path, a[0])))
    try:
        # with autograd on, detect runs eagerly, so the hooks fire; its
        # CUDA graph (autograd off) replays the same kernels without them
        with torch.enable_grad():
            pipe.detect(pipe.preprocess(run["frames"][0][0]))
    finally:
        for h in handles:
            h.remove()
    res = {}
    for path in INT8_CONVS:
        conv = pipe.model.get_submodule(path.replace("/", "."))
        xq = conv.quantize_input(seen[path])
        acc = conv.int_conv(xq)
        check(acc.dtype == torch.int32 and acc.is_cuda, f"{path}: sum is {acc.dtype} on {acc.device}")
        ref = int64_conv(torch, xq, conv)
        check(torch.equal(acc.cpu().long(), ref),
              f"{path}: the card's int32 sum differs from the CPU's int64 sum")
        res[path] = dict(input=list(xq.shape), K=conv.k * conv.k * conv.weight.shape[1],
                         cout=conv.weight.shape[0], groups=conv.groups,
                         max_abs_sum=int(ref.abs().max()))
    return res


def time_detect(torch, pipes, frames):
    """Device ms (CUDA events) of preprocess + detect per frame for each
    pipeline over the same frames; the median after `WARMUP_FRAMES`."""
    out = {}
    for name, pipe in pipes.items():
        ms = []
        for rgb, _ in frames:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            with torch.no_grad():
                pipe.detect(pipe.preprocess(rgb))
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out[name] = statistics.median(ms[WARMUP_FRAMES:])
    return out


def run_int8_app(torch, np, per_step, frames=REPLAY_BAD + 1):
    """``python -m rt3d_torch.apps.two_cam --quantize`` in-process on the
    first `frames` frames of phase 8b's recording (its last frame the one
    with a failed camera): the x sidecar being stale, it must recalibrate
    live and step an int8 model. Returns its numbers."""
    import contextlib
    import io
    import shutil
    import tempfile

    import rt3d_torch.pipeline.step as step_mod
    from rt3d_torch.models import quant

    tmp = tempfile.mkdtemp(prefix="rt3d_int8_app_")
    built, build = [], step_mod.build_pipeline
    step_mod.build_pipeline = lambda cfg, **kw: built.append(build(cfg, **kw)) or built[-1]
    err = io.StringIO()
    try:
        path = os.path.join(tmp, "seq.rts")
        record_replay(np, path)
        with contextlib.redirect_stderr(err):
            res, _ = run_app(torch, tmp, path, per_step, frames - 1, frames=frames,
                             flags=("--quantize",))
    finally:
        step_mod.build_pipeline = build
        shutil.rmtree(tmp, ignore_errors=True)
    check("stale sidecar" in err.getvalue(), "two_cam --quantize did not find the x sidecar stale")
    check(len(built) == 1 and quant.is_quantized(built[0].model),
          "two_cam --quantize stepped a model that is not quantized")
    res["quantized_convs"] = len(quant.model_act_scales(built[0].model))
    del built
    return res


X_WEIGHTS = os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz")
SIDECAR_FRAMES = FRAMES_SLICE  # 2cam_int8 on the fresh sidecar
# `tests/test_quant.py::test_quantized_detections_match_fp`'s bar: frame 11
# of the seed-4242 two-object scene, int8 against fp
BAR_FRAME, BAR_BOX_PX, BAR_SCORE = 11, 2.0, 0.05


def run_calibrate_tool(torch, tmp):
    """``python -m rt3d_torch.apps.calibrate_quant`` in-process on the x
    weights, its sidecar written into `tmp` (the committed one is left as
    it is); the sidecar must load against the weights. Returns (path,
    scales, seconds)."""
    from rt3d_torch.apps import calibrate_quant
    from rt3d_torch.models import quant

    out = os.path.join(tmp, "yolo11x_synth_seg.act_scales.json")
    torch.cuda.synchronize()
    t = time.perf_counter()
    check(calibrate_quant.main([X_WEIGHTS, "--out", out]) == 0, "calibrate_quant failed")
    secs = time.perf_counter() - t
    scales = quant.load_act_scales(out, weights_path=X_WEIGHTS)
    check(scales is not None, "load_act_scales refused the fresh x sidecar")
    with open(out) as f:
        doc = json.load(f)
    check(doc["calibration"] == {"mode": "max", "frames": 12} and len(scales) == 185,
          f"the fresh sidecar holds {len(scales)} scales, calibration {doc['calibration']}")
    return out, scales, secs


def run_int8_on_sidecar(torch, np, scales, per_step):
    """2cam_int8 built on the sidecar's scales, with no live calibration
    (`collect_act_scales` must not run), every quantized conv's scale the
    sidecar's, bit for bit equal to its plain-kernel run."""
    from rt3d_torch.models import quant

    calls = []
    collect = quant.collect_act_scales
    quant.collect_act_scales = lambda *a, **kw: calls.append(1) or collect(*a, **kw)
    try:
        run = run_preset(torch, np, "2cam_int8", SIDECAR_FRAMES, per_step,
                         label="2cam_int8_sidecar", exact=True, act_scales=scales)
    finally:
        quant.collect_act_scales = collect
    check(not calls, "2cam_int8 on the sidecar calibrated live")
    used = quant.model_act_scales(run["pipe"].model)
    check(len(used) == 98 and all(used[p] == np.float32(scales[p]) for p in used),
          "2cam_int8's quantized convs do not hold the sidecar's scales")
    return run


def run_eval_tool(torch, sidecar):
    """``python -m rt3d_torch.apps.eval_quant`` in-process on the x weights
    against the fresh sidecar: its one JSON line, fp and int8 side by
    side."""
    import contextlib
    import io

    from rt3d_torch.apps import eval_quant

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        check(eval_quant.main([X_WEIGHTS, "--scales", sidecar]) == 0, "eval_quant failed")
    secs = time.perf_counter() - t
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rec["scales"] == os.path.basename(sidecar), f"eval_quant used {rec['scales']}")
    keep = ("recall", "mean_iou", "precision", "fp_per_frame", "tp", "fp_dup", "fp_misclass",
            "fp_ghost", "gt_instances")
    rows = {k: {m: rec[k][m] for m in keep} for k in ("fp", "int8")}
    log(f"  eval_quant ({rec['frames']} frames, seed 777, conf 0.25, scales {rec['scales']}, "
        f"{secs:.2f} s): fp {json.dumps(rows['fp'])}; int8 {json.dumps(rows['int8'])}")
    return dict(rows, seconds=secs, frames=rec["frames"], grouped_excluded=rec["grouped_excluded"])


def check_int8_bar(torch, np, scales):
    """`tests/test_quant.py`'s bar on the card with the x weights: frame 11
    of the seed-4242 two-object scene through the reference 2cam config
    (the manifest's variant and input, conf 0.25, float32 resizes), fp and
    then int8 on the sidecar's scales: the same detection count (at least
    4), every int8 box within 2 px of its nearest fp box, its score within
    0.05."""
    import dataclasses

    from rt3d_torch.config import reference_2cam_config, with_cameras
    from rt3d_torch.io import SyntheticSource
    from rt3d_torch.models import quant
    from rt3d_torch.pipeline.step import build_pipeline

    with open(os.path.splitext(X_WEIGHTS)[0] + ".json") as f:
        manifest = json.load(f)
    cfg = reference_2cam_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, variant=manifest["variant"], input_hw=tuple(manifest["input_hw"]),
        conf_thresh=0.25, mask_resize_dtype="float32", preprocess_dtype="float32"))
    src = SyntheticSource(num_cameras=2, num_frames=None, hw=(720, 1280), num_objects=2,
                          seed=4242)
    pipe = build_pipeline(with_cameras(cfg, src.cameras()), weights=X_WEIGHTS)
    rgb = torch.from_numpy(src.get(BAR_FRAME).rgb).cuda()
    dets = {}
    for kind in ("fp", "int8"):
        if kind == "int8":
            quant.quantize_pipeline(pipe, X_WEIGHTS, (), scales)
        with torch.no_grad():
            d = pipe.detect(pipe.preprocess(rgb))[0]
        dets[kind] = {f: getattr(d, f).cpu().numpy() for f in ("valid", "boxes", "scores")}
    vf, vq = dets["fp"]["valid"], dets["int8"]["valid"]
    check(vf.sum() == vq.sum() and vf.sum() >= 4,
          f"frame {BAR_FRAME}: {vq.sum()} int8 detections against {vf.sum()} fp")
    box_err = score_err = 0.0
    for c in range(vf.shape[0]):
        bf, bq = dets["fp"]["boxes"][c][vf[c]], dets["int8"]["boxes"][c][vq[c]]
        sf, sq = dets["fp"]["scores"][c][vf[c]], dets["int8"]["scores"][c][vq[c]]
        for i in range(len(bf)):
            d = np.abs(bq - bf[i]).max(axis=1)
            j = int(d.argmin())
            box_err, score_err = max(box_err, float(d[j])), max(score_err, abs(sq[j] - sf[i]))
    check(box_err < BAR_BOX_PX and score_err < BAR_SCORE,
          f"frame {BAR_FRAME}: int8 boxes {box_err:.3f} px and scores {score_err:.4f} from fp")
    log(f"  frame {BAR_FRAME} of the seed-4242 scene: {int(vf.sum())} detections on both; "
        f"int8 boxes within {box_err:.4f} px and scores within {score_err:.5f} of fp "
        f"(bars {BAR_BOX_PX} px, {BAR_SCORE})")
    return dict(detections=int(vf.sum()), max_box_px=box_err, max_score=float(score_err))


# ---------------------------------------------------------------------------
# Phase 12: the training path
# ---------------------------------------------------------------------------

TRAIN_STEPS = 30
TRAIN_BATCH = 8
# the x bars of the shipped weights' held-out eval (MANIFEST_BARS["x"] in
# tests/test_detection_loop.py, copied: this script imports no test)
MANIFEST_BARS_X = {"recall": 0.93, "mean_iou": 0.78, "precision": 0.65,
                   "precision_at_08": 0.70, "easy_recall": 0.95, "easy_precision": 0.90}


def train_golden_step(torch, np):
    """(a) The float32 step of the x model on the `train_x` golden's batch,
    rebuilt from its seed (the hashes checked), then one update of the
    trainer's optimizer at warm-up 0, held within the golden's bands."""
    from rt3d_torch import golden
    from rt3d_torch.models.postprocess import letterbox_params, preprocess_frame
    from rt3d_torch.models.yolo import YoloSeg, flat_from_named, load_weights
    from rt3d_torch.train.data import build_synth_dataset
    from rt3d_torch.train.loss import seg_detection_loss
    from rt3d_torch.train.step import synth_optimizer

    model = load_weights(YoloSeg(variant="x", num_classes=80, input_hw=(384, 640)),
                         golden.TRAIN_WEIGHTS)
    model = model.to("cuda", memory_format=torch.channels_last).set_compute_dtype(torch.float32)
    t = time.perf_counter()
    batch = golden.train_batch(build_synth_dataset(model, **golden.TRAIN_DATA))
    render_s = time.perf_counter() - t
    meta = letterbox_params(golden.TRAIN_DATA["hw"], model.input_hw)
    images = torch.stack([preprocess_frame(torch.from_numpy(f).cuda(), meta)
                          for f in batch["images"]])
    targets = {k: torch.from_numpy(batch[k]).cuda() for k in golden.TRAIN_TARGETS}
    params = dict(model.named_parameters())
    loss, parts = seg_detection_loss(model, images, targets)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(loss, list(params.values()), allow_unused=True), params.values())]
    grads_np = flat_from_named(zip(params, grads))
    before = {k: p.detach().clone() for k, p in params.items()}
    params_np = flat_from_named(before.items())
    opt = synth_optimizer(**golden.TRAIN_OPT)
    with torch.no_grad():
        opt.step(opt.make(params), params, grads, opt.init(params))
    updates = flat_from_named((k, p.detach() - before[k]) for k, p in params.items())
    rec = golden.train_record(float(loss.detach()), {k: float(v) for k, v in parts.items()},
                              grads_np, updates, params_np, golden.batch_hashes(batch))
    with np.load(golden.golden_path(golden.TRAIN_GOLDEN)) as z:
        ref = {k: z[k] for k in z.files}
    m = golden.measure_train(rec, ref)
    log(f"train_x golden step (f32, TF32 off; batch rendered in {render_s:.2f} s): "
        f"loss {float(rec['loss']):.6f} (golden {float(ref['loss']):.6f}), grad norm "
        f"{float(rec['grad_global_norm']):.6f} (golden {float(ref['grad_global_norm']):.6f}); "
        f"differences {json.dumps(m)}")
    golden.check_train_bands(m)
    reuse = {"images": images, "targets": targets, "hashes": golden.batch_hashes(batch),
             "after": {k: p.detach().clone() for k, p in params.items()}}
    return dict(m, loss=float(rec["loss"]), golden_loss=float(ref["loss"]),
                render_s=render_s), reuse


TRAIN_WARMUP_STEPS = 3  # steps left out of the steady step times


def run_trainer(torch, np, tmp, smi):
    """(b) `rt3d_torch.apps.train_synth` in-process: the x model at batch 8,
    resumed from the committed weights, about 30 bf16 steps on 4 scenes x
    2 frames x 2 cameras of HD720 `mix` data; every loss finite; its
    saved `.npz` drives one frame of the 2cam preset; a step's device ops
    profiled."""
    from rt3d_torch.apps import train_synth
    from rt3d_torch.pipeline.presets import preset_config, preset_source
    from rt3d_torch.pipeline.step import build_pipeline
    from rt3d_torch.runtime.profiling import format_op_times, profile_op_times
    from rt3d_torch.train.loss import seg_detection_loss

    out = os.path.join(tmp, "x_train.npz")
    args = train_synth.parse_args([
        "--variant", "x", "--batch", str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS),
        "--scenes", "4", "--frames-per-scene", "2", "--resume",
        os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz"), "--lr", "5e-5",
        "--eval-frames", "1", "--out", out])
    # the user's settings: cuDNN may pick nondeterministic algorithms
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        res = train_synth.train(args)
        check(res["rc"] == 0, f"train_synth returned {res['rc']}")
        losses = res["losses"]
        check(len(losses) == TRAIN_STEPS, f"{len(losses)} of {TRAIN_STEPS} steps ran")
        check(all(np.isfinite(list(m.values())).all() for m in losses),
              "a training loss is not finite")
        # the kernels of the forward (with the loss), of the forward and
        # backward, and of the whole step on the last batch
        model, batch, params = res["model"], res["batch"], list(res["model"].parameters())

        def fwd_bwd():
            loss, _ = seg_detection_loss(model, batch["images"], batch)
            return torch.autograd.grad(loss, params, allow_unused=True)

        fwd_ms, _ = profile_op_times(lambda: seg_detection_loss(model, batch["images"], batch),
                                     iters=2)
        fb_ms, _ = profile_op_times(fwd_bwd, iters=2)
        total, per_op = profile_op_times(lambda: res["step_fn"](res["state"], batch), iters=2)
    finally:
        torch.backends.cudnn.deterministic = det
    step_ms = statistics.median(res["step_ms"][TRAIN_WARMUP_STEPS:])
    split = {"forward": fwd_ms, "backward": fb_ms - fwd_ms, "optimizer": total - fb_ms}
    r = {k: res[k] for k in ("render_s", "stage_s", "train_s", "peak_mib", "samples")}
    r.update(step_ms=step_ms, first_step_ms=res["step_ms"][0],
             images_per_s=TRAIN_BATCH * 1e3 / step_ms, steps_per_s=1e3 / step_ms,
             wall_steps_per_s=TRAIN_STEPS / res["train_s"], kernel_ms=total,
             device_busy=total / step_ms, kernel_split_ms=split,
             first_loss=losses[0], last_loss=losses[-1])
    log(f"  {smi}: train_synth x, batch {TRAIN_BATCH}, {TRAIN_STEPS} bf16 steps: device ms "
        f"a step {step_ms:.2f} (median of steps "
        f"{TRAIN_WARMUP_STEPS}-{TRAIN_STEPS - 1}; step 0 {res['step_ms'][0]:.1f}), "
        f"{r['images_per_s']:.1f} images/s, {r['steps_per_s']:.2f} steps/s "
        f"({r['wall_steps_per_s']:.2f} by the wall clock, step 0 included), peak "
        f"{r['peak_mib']:.1f} MiB; dataset of {r['samples']} samples rendered in "
        f"{r['render_s']:.2f} s, staged in {r['stage_s']:.2f} s; loss "
        f"{losses[0]['loss']:.4f} -> {losses[-1]['loss']:.4f}")
    log(f"  profiled (2 calls each): kernels {total:.2f} ms a step ({total / step_ms:.3f} of "
        f"the step's device ms); kernel ms of the forward with the loss, the backward and the "
        f"optimizer: {json.dumps({k: round(v, 3) for k, v in split.items()})}\n"
        + format_op_times(total, per_op, top=12))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    # the saved weights drive the 2cam preset
    src = preset_source("2cam", 1)
    pipe = build_pipeline(preset_config("2cam", src), weights=out, device="cuda")
    pkt = src.get(0)
    _, o = pipe.step(pipe.init_state(), torch.from_numpy(pkt.rgb).cuda(),
                     torch.from_numpy(pkt.depth).cuda(), pipe.calib())
    n_det = int(o.detections.valid.sum())
    check(n_det > 0 and bool(torch.isfinite(o.detections.boxes).all()),
          "the trained weights found nothing in the 2cam frame")
    log(f"  {os.path.basename(out)} ({os.path.getsize(out) / 1e6:.1f} MB) in the 2cam preset: "
        f"{n_det} detections on frame 0")
    r["preset_detections"] = n_det
    return r


def check_eval(torch):
    """(c) The port's `evaluate_weights` on the committed x weights at the
    manifest's eval settings, held to the x bars, the easy family beside
    it."""
    from rt3d_torch.train.eval import evaluate_weights

    path = os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz")
    with open(os.path.splitext(path)[0] + ".json") as f:
        manifest = json.load(f)
    ev = dict(variant="x", hw=tuple(manifest["train_hw"]), input_hw=tuple(manifest["input_hw"]),
              num_frames=manifest["eval"]["frames"], seed=manifest["seed"] + 777,
              conf_thresh=manifest["eval"]["conf_thresh"], device="cuda")
    hard = evaluate_weights(path, domain="hard", **ev)
    easy = evaluate_weights(path, domain="easy", **ev)
    keep = ("recall", "mean_iou", "precision", "fp_per_frame", "tp", "fp_dup",
            "fp_misclass", "fp_ghost", "gt_instances")
    log(f"  eval of {os.path.basename(path)} (seed {ev['seed']}, {ev['num_frames']} frames, "
        f"conf {ev['conf_thresh']}): hard {json.dumps({k: hard[k] for k in keep})}, precision "
        f"@0.8 {hard['by_conf']['0.8']['precision']:.4f}; easy "
        f"{json.dumps({k: easy[k] for k in keep})}; the JAX manifest's: hard recall "
        f"{manifest['eval']['recall']:.4f}, mean IoU {manifest['eval']['mean_iou']:.4f}, "
        f"precision {manifest['eval']['precision']:.4f}")
    b = MANIFEST_BARS_X
    for key, got in (("recall", hard["recall"]), ("mean_iou", hard["mean_iou"]),
                     ("precision", hard["precision"]),
                     ("precision_at_08", hard["by_conf"]["0.8"]["precision"]),
                     ("easy_recall", easy["recall"]), ("easy_precision", easy["precision"])):
        check(got >= b[key], f"eval: {key} {got:.4f} under the x bar {b[key]}")
    return {"hard": {k: hard[k] for k in keep}, "hard_precision_at_08":
            hard["by_conf"]["0.8"]["precision"], "easy": {k: easy[k] for k in keep}}


# ---------------------------------------------------------------------------
# Phase 13: the camera-sharded step, the mesh train step, track_only, viewer
# ---------------------------------------------------------------------------

SHARDED_FRAMES = {"2cam": 6, "stretch_4cam_1mm": 2}


def same_state(torch, a, b):
    """True when two `PipelineState`s hold equal tensors everywhere."""
    return (len(a.trackers) == len(b.trackers)
            and all(same_outputs(torch, x, y) for x, y in zip(a.trackers, b.trackers))
            and torch.equal(a.prev_gray, b.prev_gray) and same_outputs(torch, a.accum, b.accum))


def check_sharded(torch, name, per_step):
    """(b), (c): `make_sharded_step` on the world-1 process group against
    the preset's own `Pipeline.step` on the same frames: outputs and state
    bit for bit after every frame, each kernel's launches per step as the
    preset's, and the device ms of each frame (CUDA events; the two steps
    take turns going first)."""
    from rt3d_torch import kernels
    from rt3d_torch.parallel import make_sharded_step
    from rt3d_torch.pipeline.presets import synthetic_preset

    n_frames = SHARDED_FRAMES[name]
    gc.collect()
    torch.cuda.empty_cache()
    pipe, src = synthetic_preset(name, n_frames)
    sharded = make_sharded_step(pipe)
    check((sharded.lo, sharded.hi) == (0, pipe.cfg.rig.num_cameras),
          f"{name}: rank 0 of 1 holds cameras [{sharded.lo}, {sharded.hi})")
    runs = {"step": (pipe.step, pipe.init_state(), pipe.calib()),
            "sharded": (sharded, sharded.init_state(), sharded.calib())}
    ms = {k: [] for k in runs}
    launches = {k: dict.fromkeys(per_step, 0) for k in runs}
    for i in range(n_frames):
        pkt = src.get(i)
        rgb, depth = torch.from_numpy(pkt.rgb).cuda(), torch.from_numpy(pkt.depth).cuda()
        outs = {}
        for which in (("step", "sharded") if i % 2 == 0 else ("sharded", "step")):
            fn, state, calib = runs[which]
            before = dict(kernels.LAUNCHES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            state, outs[which] = fn(state, rgb, depth, calib)
            b.record()
            torch.cuda.synchronize()
            ms[which].append(a.elapsed_time(b))
            runs[which] = (fn, state, calib)
            for k, n in per_step.items():
                rose = kernels.LAUNCHES[k] - before[k]
                check(rose == n, f"{name} {which} frame {i}: {k} launched {rose} times, "
                      f"expected {n}")
                launches[which][k] += rose
        check(same_outputs(torch, outs["sharded"], outs["step"]),
              f"{name} frame {i}: the sharded step's outputs differ from Pipeline.step's")
        check(same_state(torch, runs["sharded"][1], runs["step"][1]),
              f"{name} frame {i}: the sharded step's state differs from Pipeline.step's")
        log(f"  {name} frame {i}: Pipeline.step {ms['step'][-1]:.2f} ms, sharded "
            f"{ms['sharded'][-1]:.2f} ms device clock; equal outputs and state "
            f"({int(outs['step'].detections.valid.sum())} detections, "
            f"{int(outs['step'].workspace.valid.sum())} workspace points)")
    check(sum(int(o.detections.valid.sum()) for o in outs.values()) > 0,
          f"{name}: no detection on the last frame")
    steady = slice(WARMUP_FRAMES, None) if n_frames > WARMUP_FRAMES else slice(1, None)
    res = {"frames": n_frames, "launches": launches["sharded"], "launches_per_step": {
        k: v // n_frames for k, v in launches["sharded"].items()}}
    for k, v in ms.items():
        res[f"{k}_ms"] = statistics.median(v[steady])
    log(f"  {name}: steady device ms (median of frames {steady.start}-{n_frames - 1}): "
        f"Pipeline.step {res['step_ms']:.2f}, sharded {res['sharded_ms']:.2f}")
    return res


def mesh_train_step(torch, np, reuse):
    """(d) `make_train_step(mesh=make_mesh({"dp": 1, "fsdp": 1}))` on the
    `train_x` golden's batch (f32, TF32 off), from the committed weights:
    one step within the golden's bands, its largest parameter difference
    from phase 12a's step, then its device ms beside the unsharded
    `make_train_step`'s on the same batch (two more steps each, in turns)."""
    from dataclasses import fields

    from rt3d_torch import golden
    from rt3d_torch.models.yolo import YoloSeg, flat_from_named, load_weights
    from rt3d_torch.parallel import make_mesh
    from rt3d_torch.train.step import AdamW, TrainState, make_train_step, synth_optimizer

    seen = {}

    class Recording(AdamW):
        """The trainer's optimizer, keeping the whole gradient it was given."""

        def step(self, opt, params, grads, state, **kw):
            seen["grads"] = {k: g.detach().full_tensor().clone() if hasattr(g, "full_tensor")
                             else g.detach().clone() for k, g in zip(params, grads)}
            super().step(opt, params, grads, state, **kw)

    opt = synth_optimizer(**golden.TRAIN_OPT)
    rec_opt = Recording(**{f.name: getattr(opt, f.name) for f in fields(opt)})
    full = {k: p.detach().cuda() for k, p in load_weights(
        YoloSeg(variant="x", num_classes=80, input_hw=(384, 640)),
        golden.TRAIN_WEIGHTS).named_parameters()}
    batch = {"images": reuse["images"], **reuse["targets"]}
    res = {}
    steps = {}
    for name, mesh in (("mesh", make_mesh({"dp": 1, "fsdp": 1})), ("unsharded", None)):
        model = YoloSeg(variant="x", num_classes=80, input_hw=(384, 640)).cuda()
        model.set_compute_dtype(torch.float32)
        init_fn, step_fn = make_train_step(model, rec_opt if mesh else opt, mesh=mesh)
        st = init_fn(0)
        st = TrainState(params=full, opt_state=st.opt_state, step=st.step)
        st, metrics = step_fn(st, batch)
        steps[name] = [step_fn, st]
        if mesh is None:
            continue
        check(all(len(p.placements) == 2 for p in st.params.values()),
              "the mesh step's parameters are not sharded over the 2-D mesh")
        after = {k: p.detach().full_tensor() for k, p in st.params.items()}
        grads = seen.pop("grads")
        rec = golden.train_record(
            float(metrics["loss"]), {k: float(v) for k, v in metrics.items() if k != "loss"},
            flat_from_named(grads.items()),
            flat_from_named((k, after[k] - full[k]) for k in full),
            flat_from_named(full.items()), reuse["hashes"])
        with np.load(golden.golden_path(golden.TRAIN_GOLDEN)) as z:
            ref = {k: z[k] for k in z.files}
        m = golden.measure_train(rec, ref)
        golden.check_train_bands(m)
        diff = max(float((after[k] - reuse["after"][k]).abs().max()) for k in after)
        upd = rec["update_norms"]
        res.update(m, loss=float(rec["loss"]), golden_loss=float(ref["loss"]),
                   max_param_diff_from_12a=diff, update_norm_max=float(upd.max()),
                   update_norm_median=float(np.median(upd)))
        log(f"  mesh step (dp 1 x fsdp 1): loss {res['loss']:.6f} (golden "
            f"{res['golden_loss']:.6f}), update norms median {res['update_norm_median']:.3e} "
            f"max {res['update_norm_max']:.3e}, largest parameter difference from phase "
            f"12a's step {diff:.3e}; differences from the golden {json.dumps(m)}")
        del after, grads
    ms = {k: [] for k in steps}
    for name in ("unsharded", "mesh", "mesh", "unsharded"):
        step_fn, st = steps[name]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        steps[name][1], _ = step_fn(st, batch)
        b.record()
        torch.cuda.synchronize()
        ms[name].append(a.elapsed_time(b))
    for k, v in ms.items():
        res[f"{k}_step_ms"] = statistics.mean(v)
    log(f"  train step device ms (batch 2, f32, mean of 2): unsharded "
        f"{res['unsharded_step_ms']:.2f}, mesh {res['mesh_step_ms']:.2f}")
    return res


def run_track_only(torch, tmp):
    """(e) `python -m rt3d_torch.apps.track_only` in-process on 6 synthetic
    HD720 frames of one camera (x model) with ``--live`` into a spool, then
    `viewer --once` on that spool, headless."""
    import contextlib
    import io

    from rt3d_torch.apps import track_only, viewer

    spool = os.path.join(tmp, "spool")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = track_only.main([
            "--source", "synthetic", "--frames", "6", "--variant", "x", "--weights",
            os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz"), "--device", "cuda",
            "--live", spool, "--log-dir", os.path.join(tmp, "runs")])
    text = out.getvalue().splitlines()
    for line in text:
        log(f"  track_only: {line}")
    check(rc == 0, f"track_only exited {rc}")
    boxes = [ln for ln in text if " id=" in ln]
    check(len(boxes) > 0 and any("FPS" in ln for ln in text),
          "track_only printed no detection or no FPS line")
    with open(os.path.join(spool, "status.json")) as f:
        status = json.load(f)
    frame = [n for n in ("frame.png", "frame.npy") if os.path.exists(os.path.join(spool, n))]
    check(status["frame"] == 5 and len(frame) == 1,
          f"spool: status {status}, frames {frame}")
    if frame == ["frame.npy"]:
        panel = np.load(os.path.join(spool, "frame.npy"))
        check(panel.shape == (720, 1280, 3) and panel.dtype == np.uint8,
              f"spool frame.npy is {panel.shape} {panel.dtype}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        vrc = viewer.main([spool, "--once"])
    log(f"  viewer --once: exit {vrc}: {out.getvalue().strip()}")
    check(vrc == 0 and "frame 5" in out.getvalue(), "viewer --once did not show frame 5")
    return {"detection_lines": len(boxes), "status": status, "frame_file": frame[0],
            "viewer_rc": vrc}


def os_threads():
    """Id -> name of each of this process's threads, the native ones
    (NCCL's watchdog, heartbeat and proxy threads) as well as Python's."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                out[tid] = f.read().strip()
        except OSError:     # the thread ended while we listed
            pass
    return out


def check_parallel(torch, np, train_reuse, none):
    """Phase 13 on a world-1 NCCL process group (an in-process store, no
    port, no other process), destroyed on every way out: no thread that
    the group started, native ones included, outlives it (a few seconds
    are allowed for them to end), and no Python thread is left behind."""
    import shutil
    import threading

    import torch.distributed as dist

    threads = threading.active_count()
    tasks = os_threads()
    res = {}
    # NCCL names its threads; its RAS service, which listens on a TCP port
    # for the `ncclras` client and keeps its thread for the life of the
    # process, stays off: this script opens no socket
    os.environ["NCCL_SET_THREAD_NAME"] = "1"
    os.environ["NCCL_RAS_ENABLE"] = "0"
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        started = sorted(v for k, v in os_threads().items() if k not in tasks)
        check("pt_nccl_watchdg" in started,
              f"no NCCL watchdog among the group's new threads {started}")
        log(f"  the process group started the threads {started}")
        t = time.perf_counter()
        res["sharded_2cam"] = check_sharded(torch, "2cam", {
            **none, "window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1,
            "min_sqdist": 1})
        phase("sharded 2cam", t)
        t = time.perf_counter()
        res["sharded_stretch_4cam_1mm"] = check_sharded(
            torch, "stretch_4cam_1mm", {**none, "min_sqdist": 1})
        phase("sharded stretch_4cam_1mm", t)
        t = time.perf_counter()
        res["mesh_train_step"] = mesh_train_step(torch, np, train_reuse)
        phase("mesh train step", t)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    during = len(os_threads())
    deadline = time.monotonic() + 10.0
    while True:
        now = os_threads()
        left = {k: v for k, v in now.items() if k not in tasks}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"threads left behind by the process group: {sorted(left.values())}")
    res["os_threads"] = {"before": len(tasks), "started": started, "after_destroy": during,
                         "after": len(now)}
    log(f"  os threads: {len(tasks)} before the process group, {during} just after "
        f"its destruction, {len(now)} when its threads had ended")
    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rt3d_live_")
    try:
        res["track_only"] = run_track_only(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("track_only and viewer", t)
    check(threading.active_count() == threads,
          f"{threading.active_count() - threads} threads left behind by phase 13")
    return res


# ---------------------------------------------------------------------------
# Phases 4-8: the presets' paths
# ---------------------------------------------------------------------------


# greedy solves in a camera's tracker step: ByteTrack's and BoT-SORT's
# three association rounds, DeepSORT's two
GREEDY_SOLVES = {"bytetrack": 3, "botsort": 3, "deepsort": 2}


def run_path(torch, pipe, frames, per_step):
    """Step all frames in order; returns (per-frame event ms, wall s, host
    copies of the outputs, launches per kernel, last frame's outputs, the
    state the last frame was stepped from). The greedy kernel's launches
    are those the step's path ran: a replay of the track stage's graph runs
    every solve the capture recorded, and no Python counts them, while the
    capturing step counted each solve twice, in the warm-up and in the
    capture; checked against its solves a step on every frame."""
    from rt3d_torch import kernels
    from rt3d_torch.runtime import graphs

    state, calib = pipe.init_state(), pipe.calib()
    kernels.reset_launches()
    t = pipe.cfg.tracker
    solves = 0 if pipe.plain_kernels or t.assignment == "exact" else (
        GREEDY_SOLVES[t.tracker_type] * len(state.trackers))
    greedy = 0
    ms, outs = [], []
    t_wall = None
    for i, (rgb, depth) in enumerate(frames):
        if i == WARMUP_FRAMES:
            torch.cuda.synchronize()
            t_wall = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        graph = pipe._track_graph
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prev = state
        with recording(graphs, "replayed") as calls:
            state, out = pipe.step(state, rgb, depth, calib)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        for name, n in per_step.items():
            rose = kernels.LAUNCHES[name] - before[name]
            check(rose == n, f"frame {i}: {name} launched {rose} times, expected {n}")
        captured = pipe._track_graph is not None and pipe._track_graph is not graph
        replays = sum(c[1] == "track" for c in calls)
        ran = (kernels.LAUNCHES["greedy_match"] - before["greedy_match"]
               + (replays - 2 * captured) * solves)
        check(ran == solves, f"frame {i}: greedy_match ran {ran} times "
              f"({replays} track graph replays), expected {solves}")
        greedy += ran
        outs.append(host_outputs(out))
    wall = time.perf_counter() - t_wall
    return ms, wall, outs, {**kernels.LAUNCHES, "greedy_match": greedy}, out, prev


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


def run_preset(torch, np, name, n_frames, per_step, label=None, exact=False, **build):
    """Phases of one preset: step `n_frames` synthetic HD720 frames with
    every launch counter checked per step and the outputs checked, then the
    same frames with every kernel's plain version, compared (with `exact`,
    every output bit for bit, boxes and scores too, and the last frame's
    outputs through `same_outputs`). `build` goes to `synthetic_preset` for
    both runs; `label` names the run in the log (default `name`). Returns
    the run's numbers, its pipeline, frames and last outputs."""
    from rt3d_torch.pipeline.presets import synthetic_preset

    label = label or name

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    pipe, src = synthetic_preset(name, n_frames, **build)
    frames = []
    for i in range(n_frames):
        pkt = src.get(i)
        frames.append((torch.from_numpy(pkt.rgb).cuda(), torch.from_numpy(pkt.depth).cuda()))
    torch.cuda.synchronize()
    log(f"{label}: pipeline built and {n_frames} frames staged: "
        f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ms, wall, outs, launches, last, prev = run_path(torch, pipe, frames, per_step)
    peak = torch.cuda.max_memory_allocated()
    total_dets = 0
    for i, o in enumerate(outs):
        for key in ("boxes", "scores", "pc_points", "obj_points", "flat_points", "ws_points"):
            check(bool(np.isfinite(o[key]).all()), f"{label} frame {i}: non-finite {key}")
        check(isinstance(o["overflow"], int), "overflow is not an integer")
        n_det = int(o["det_valid"].sum())
        total_dets += n_det
        log(f"  frame {i}: {ms[i]:.2f} ms device clock, detections {n_det} "
            f"(classes {o['classes'][o['det_valid']].tolist()}), track ids "
            f"{o['track_ids'][o['det_valid']].tolist()}, fused objects "
            f"{int(o['obj_present'].sum())}, object points {int(o['flat_valid'].sum())}, "
            f"workspace kept {int(o['ws_valid'].sum())}, overflow {o['overflow']}")
    check(total_dets > 0, f"{label}: no detection in any frame")
    steady = ms[WARMUP_FRAMES:]
    fps = (n_frames - WARMUP_FRAMES) / wall
    log(f"  steady frames: device ms mean {statistics.mean(steady):.2f} "
        f"median {statistics.median(steady):.2f}; wall fps {fps:.2f}; "
        f"peak memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the "
        f"preset was built); launches {launches}")
    phase(f"{label} path", t)

    t = time.perf_counter()
    plain, _ = synthetic_preset(name, n_frames, plain_kernels=True, **build)
    pms, _, pouts, _, plast, _ = run_path(torch, plain, frames, {n: 0 for n in per_step})
    same = ("classes", "det_valid", "track_ids", "pc_points", "pc_valid", "obj_points",
            "obj_valid", "obj_present", "flat_points", "flat_valid", "ws_points", "ws_valid")
    close = ("boxes", "scores")
    if exact:
        same, close = same + close, ()
    for i, (o, p) in enumerate(zip(outs, pouts)):
        for key in same:
            check(np.array_equal(o[key], p[key]),
                  f"{label} frame {i}: {key} differs from the plain run")
        for key in close:
            check(np.allclose(o[key], p[key], rtol=0, atol=1e-4),
                  f"{label} frame {i}: {key} differ from the plain run by more than 1e-4")
        check(o["overflow"] == p["overflow"], f"{label} frame {i}: overflow differs")
    check(not exact or same_outputs(torch, last, plast),
          f"{label}: the last frame's outputs differ from the plain run's")
    del plast
    log(f"  plain run: steady device ms mean {statistics.mean(pms[WARMUP_FRAMES:]):.2f}; "
        f"identical {'outputs' if exact else 'keys, ids and keep masks'} over {n_frames} frames")
    phase(f"{label} plain path", t)
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
    if a is None or b is None:
        return a is b
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


def run_app(torch, tmp, path, per_step, steps, frames=REPLAY_FRAMES, flags=()):
    """`rt3d_torch.apps.two_cam.main` in-process on the first `frames`
    frames of the recording, as a user runs it (with `flags`); checks its
    exit code, replay backend, CSVs and launches. Returns its printed
    numbers and launches."""
    import contextlib
    import csv
    import io

    from rt3d_torch import kernels
    from rt3d_torch.apps import two_cam

    log_dir = os.path.join(tmp, "runs")
    argv = ["--source", path, "--variant", "x",
            "--weights", os.path.join(ROOT, "weights", "yolo11x_synth_seg.npz"),
            "--frames", str(frames), "--warmup", "2", "--pipeline-depth", "2",
            "--device", "cuda", "--log-dir", log_dir, *flags]
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
          and len(rows.get("Frame Retrieval", ())) == frames,
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
        for c in r.get("large_k", []) + r.get("wide_window", []):
            log(f"    {'k ' + str(c['k']) if 'k' in c else 'window ' + str(tuple(c['window']))}: "
                f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, library "
                f"{c['library_ms']}, bound {fmt_bound(c)}, bit for bit")
    phase("kernels", t)

    # 4-5. the default main path, then its plain run
    none = {"window_dedupe": 0, "window_prev_or": 0, "sor_knn_slots": 0,
            "min_sqdist": 0, "sor_knn": 0, "sor_knn_slots_large_k": 0, "sor_knn_large_k": 0}
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

    # 4d. 2cam with sor_nb_neighbors = 50: K3 through its large-k kernel,
    # bit for bit equal to its plain run
    runs["2cam_k50"] = run_preset(torch, np, "2cam", FRAMES_SLICE, {
        **none, "window_dedupe": 2, "window_prev_or": 2, "sor_knn_slots": 1,
        "sor_knn_slots_large_k": 1, "min_sqdist": 1}, label="2cam_k50", exact=True,
        pipeline={"sor_nb_neighbors": 50})
    log(f"  steady device ms a frame: 2cam_k50 {runs['2cam_k50']['steady_ms']:.2f}, "
        f"2cam (k = 20) {runs['2cam']['steady_ms']:.2f}")
    for key in drop:
        runs["2cam_k50"].pop(key, None)

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

    # 11. the int8 backbone: live calibration, the path and its plain run,
    # the int32 sums against the CPU, detect int8 against bf16, the app
    t = time.perf_counter()
    scales, calib_s, bf16_pipe = calibrate_int8(torch)
    log(f"2cam_int8: live calibration of {len(scales)} convs on 4 frames: {calib_s:.2f} s")
    phase("2cam_int8 calibration", t)
    runs["2cam_int8"] = run_preset(torch, np, "2cam_int8", FRAMES, slice_k, act_scales=scales)
    t = time.perf_counter()
    int8 = {"calibration_s": calib_s, "sums": check_int8_sums(torch, runs["2cam_int8"])}
    for path, r in int8["sums"].items():
        log(f"  {path}: int32 sums equal the CPU's int64 sums ({json.dumps(r)})")
    int8["detect_ms"] = time_detect(torch, {"int8": runs["2cam_int8"]["pipe"], "bf16": bf16_pipe},
                                    runs["2cam_int8"]["frames"])
    log(f"  detect (preprocess + forward + decode + NMS), median device ms over frames "
        f"{WARMUP_FRAMES}-{FRAMES - 1}: int8 {int8['detect_ms']['int8']:.2f}, "
        f"bf16 {int8['detect_ms']['bf16']:.2f}")
    del bf16_pipe
    for key in drop:
        runs["2cam_int8"].pop(key, None)
    int8["app"] = run_int8_app(torch, np, slice_k)
    log(f"  two_cam --quantize: {json.dumps(int8['app'])}")
    phase("2cam_int8 sums, detect and app", t)

    # 11b. the int8 tools: a fresh x sidecar from calibrate_quant, 2cam_int8
    # on it, eval_quant fp against int8, and test_quant's bar on frame 11
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rt3d_sidecar_") as tmp:
        sidecar, side_scales, calib_tool_s = run_calibrate_tool(torch, tmp)
        log(f"calibrate_quant: {len(side_scales)} scales in {calib_tool_s:.2f} s, loaded "
            f"against the x weights")
        runs["2cam_int8_sidecar"] = run_int8_on_sidecar(torch, np, side_scales, slice_k)
        for key in drop:
            runs["2cam_int8_sidecar"].pop(key, None)
        int8["tools"] = {"calibrate_s": calib_tool_s, "convs": len(side_scales),
                         "eval": run_eval_tool(torch, sidecar),
                         "bar": check_int8_bar(torch, np, side_scales)}
    phase("int8 tools", t)

    # 9. every preset against the JAX golden
    t = time.perf_counter()
    gold = check_golden(torch)
    phase("golden", t)

    # 12. the training path: the golden step, the trainer, the evaluation
    t = time.perf_counter()
    train = {}
    train["golden_step"], train_reuse = train_golden_step(torch, np)
    phase("train_x golden step", t)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rt3d_train_") as tmp:
        train["trainer"] = run_trainer(torch, np, tmp, smi)
    phase("train_synth x", t)
    t = time.perf_counter()
    train["eval"] = check_eval(torch)
    phase("eval of the x weights", t)

    # 13. the sharded step and the mesh train step on a world-1 process
    # group; track_only --live and viewer --once
    parallel = check_parallel(torch, np, train_reuse, none)
    del train_reuse

    launches = {name: dict(r["launches"]) for name, r in runs.items()}
    launches["sor_entry"] = sor_entry
    launches["replay"] = launches_replay
    for name in ("2cam", "stretch_4cam_1mm"):
        launches[f"sharded_{name}"] = dict(parallel[f"sharded_{name}"]["launches"])
    step_rows["2cam"]["sor_knn_slots"] = slot_row
    out_rows = []
    for r in rows:
        path = "sor_entry" if r["name"] == "sor_knn" else "2cam"
        steps = {p: v[r["name"]] for p, v in step_rows.items() if v.get(r["name"])}
        # the greedy kernel's launches are counted where `run_path` counts
        # the track graph's replays: the presets' paths
        paths = runs if r["name"] == "greedy_match" else launches
        out_rows.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[path][r["name"]], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], **r["bound"], library_ms=r["library_ms"],
            launch_floor_ms=floor_ms,
            launches_by_path={p: launches[p][r["name"]] for p in paths},
            **({"exact_ms": r["exact_ms"]} if "exact_ms" in r else {}),
            **({"step_inputs": steps} if steps else {}),
            **({"large_k": r["large_k"], "large_k_launches_by_path": {
                p: n[f"{r['name']}_large_k"] for p, n in launches.items()}}
               if "large_k" in r else {}),
            **({"wide_window": r["wide_window"]} if "wide_window" in r else {})))
    log(json.dumps({"presets": {name: {k: r[k] for k in ("steady_ms", "fps", "peak_mib",
                                                          "plain_ms")}
                                for name, r in runs.items()},
                    "replay": replay, "accumulator": accum, "int8": int8}))
    log(json.dumps({"train": train}))
    log(json.dumps({"parallel": parallel}))
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
