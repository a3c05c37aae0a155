#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (`rt3d_torch`): one run of one
cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: set-up (render the cell's frames, or read them back from the
checkout's `build/`, build the program's pipeline and its
`PipelineDriver`, warm up every shape on the first frames), timed as
`setup_s`; the window, a closed loop through
`PipelineDriver.run` in chunks until `--seconds` have passed; with
`--trace 1` the host spans of every frame and a profiler slice; the
comparison with the plain reference (`bench_port.check`). What depends on
the model, the stated config, the FLOPs an image, the control's lower
precision, the reference and any numbers or faults of its own, comes from the module of the architecture
that the configuration file names (`arch/<name>.py`). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`, each
compared number with its limit. Those numbers are also the last lines of
standard error.

It needs as many CUDA devices as the cell asks for and exits with 3
otherwise, printing no result; it exits with 4 if JAX, flax or the JAX
package `rt3d` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package is imported as `bench_port` from the checkout's root; the
# script's own folder comes off the path, so that its modules shadow none
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "rt3d")
STAGE_NAMES = ("YOLO11 Inference", "Mask Processing", "Point Cloud Processing",
               "Point Cloud Fusion", "Subtraction")
RENDER_WORKERS = 4
FRAME_CACHE = os.path.join(ROOT, "build", "bench_port", "frames")


def few_threads() -> None:
    """One process with few threads: the host drives the step from one
    thread, and idle pools of worker threads only take cores from it. Call
    before torch or numpy is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def rendered_frames(scene, traffic):
    """The cell's rendered frames, [(rgb, depth)]: rendered once into the
    checkout's `build/bench_port/frames/`, keyed by the traffic block and
    the traffic generator's source, and read back by later runs."""
    import hashlib

    import numpy as np

    from bench_port import synthetic

    h = hashlib.sha256(json.dumps(traffic, sort_keys=True).encode())
    with open(synthetic.__file__, "rb") as f:
        h.update(f.read())
    paths = [os.path.join(FRAME_CACHE, f"{h.hexdigest()[:24]}.{part}.npy")
             for part in ("rgb", "depth")]
    if all(os.path.exists(p) for p in paths):
        rgb, depth = (np.load(p) for p in paths)
    else:
        frames = scene.render_all(traffic["rendered_frames"], RENDER_WORKERS)
        rgb = np.stack([f[0] for f in frames])
        depth = np.stack([f[1] for f in frames])
        os.makedirs(FRAME_CACHE, exist_ok=True)
        for p, a in zip(paths, (rgb, depth)):
            with open(p + ".partial", "wb") as f:
                np.save(f, a)
            os.replace(p + ".partial", p)
    return [(rgb[i], depth[i]) for i in range(rgb.shape[0])]


def build_program(cell, scene, device, control: bool = False, frames=()):
    """The program's pipeline for the cell's configuration, with the
    committed weights; with `control`, the configuration file's `control`
    overrides applied and the architecture's `control(pipe, weights, conf,
    frames)` switching on its lower-precision path. The program's configuration has to hold
    every field of the one that the configuration file states through its
    architecture's frozen config classes (`arch/<name>.py`), at the same
    value, and pass the architecture's own checks."""
    from bench_port import spec
    from rt3d_torch import config as pconfig
    from rt3d_torch.pipeline.step import build_pipeline

    c, arch = cell["config_spec"], cell["arch"]
    model = dict(c.get("model", {}))
    if control:
        model.update(c["control"].get("model", {}))
    cfg = spec.make_config(pconfig, dict(c, model=model), scene.cameras())
    stated = arch.stated_config(dict(c, model=model), scene.cameras())
    differ, extra = spec.config_differences(cfg, stated)
    if differ:
        raise ValueError(f"config {cell['config']}: the program's configuration differs from "
                         f"the one stated: {'; '.join(differ)}")
    if extra:
        log(f"config {cell['config']}: fields of the program's configuration that the stated "
            f"one lacks: {', '.join(extra)}")
    try:
        arch.check_program(cfg, c)
    except ValueError as e:
        raise ValueError(f"config {cell['config']}: {e}") from e
    if cfg.rig.num_cameras != c["cameras"]:
        raise ValueError(f"config {cell['config']}: {cfg.rig.num_cameras} cameras, not {c['cameras']}")
    weights = os.path.join(ROOT, c["weights"])
    pipe = build_pipeline(cfg, weights=weights, device=device)
    if control:
        arch.control(pipe, weights, c, frames)
    return pipe, weights


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             here: str = None, control: bool = False, fault=None, bench=None):
    """One run of cell `name`. Returns (the result line's object, every
    number the comparison gives, compared or not). `here` is the folder
    holding `configs/` and `workloads/`, and any `arch/`, `bounds/` and
    `metrics/` files that stand beside or over the benchmark's own;
    `control` runs the program's int8 path in its place; `fault(pipe)`
    (`bench_port.faults`) breaks the program underneath; `bench` stands in
    for `BENCHMARK.json`."""
    import torch

    from bench_port import check, drive, spec, stats
    from bench_port.synthetic import EasyScene, cycle
    from rt3d_torch.runtime.driver import PipelineDriver

    here = here or spec.HERE
    cell = spec.workload(name, here)
    traffic, conf, arch = cell["traffic"], cell["config_spec"], cell["arch"]
    scene = EasyScene(traffic["cameras"], traffic["objects"], traffic["scene_seed"],
                      tuple(traffic["hw"]))
    frames = rendered_frames(scene, traffic)
    pipe, weights = build_program(cell, scene, device, control, frames)
    undo = fault(pipe) if fault is not None else None
    driver = PipelineDriver(pipe, mode="fused", pipeline_depth=traffic["pipeline_depth"],
                            frames_per_dispatch=1)
    source = drive.ReplaySource(frames, seed % cycle(len(frames)))
    recorder = drive.Recorder(driver, source, cell["check"]["frames"], seed)
    tracer = None
    if trace:
        from bench_port.tracer import Tracer

        tracer = Tracer(pipe, here)
        tracer.install()
    cuda = device == "cuda"
    warm = traffic["warmup_frames"]
    drive.run_frames(driver, source, recorder, 0, warm)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    n_ret0 = len(driver.log.values["Frame Retrieval"])
    t_open, t_close, g_next = drive.run_window(driver, source, recorder, warm, seconds,
                                               traffic["chunk_frames"])
    done = [recorder.done[g] for g in sorted(recorder.done) if g >= warm]
    capture = [source.capture[g] for g in sorted(recorder.done) if g >= warm]
    in_window = stats.frames_in_window(done, t_open, t_close)
    lat = stats.latencies(capture, done, t_open, t_close)
    if not lat:
        raise RuntimeError(f"no frame was done inside the {seconds} s window")
    fps = len(in_window) / seconds
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    slices = [0] * max(int(seconds // 5), 1)
    for i in in_window:
        slices[min(int((done[i] - t_open) // 5), len(slices) - 1)] += 1
    log(f"frames done in each 5 s of the window: {slices}")
    log(f"window: {len(in_window)} frames done in {seconds} s ({len(done)} stepped), "
        f"fps {fps}, latency p50 {stats.percentile(lat, 50) * 1e3} ms, "
        f"p95 {stats.percentile(lat, 95) * 1e3} ms, peak device memory {peak} bytes, "
        f"skipped {driver.skipped_frames}")

    metrics, breakdown, dev_extra = {}, None, {}
    bench = bench or spec.benchmark(ROOT)
    if not trace:
        values = dict(fps=fps, latency_p95_ms=stats.percentile(lat, 95) * 1e3, setup_s=setup_s)
        for m in spec.cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tracer.profile(lambda: drive.run_frames(driver, source, recorder, g_next,
                                                cell["trace"]["profiled_frames"]))
        summary = tracer.summary(STAGE_NAMES)
        window_frames = {warm + i for i in in_window}
        record = dict(
            frames=sorted(window_frames),
            retrieval_s=driver.log.values["Frame Retrieval"][n_ret0:n_ret0 + len(in_window)],
            spans=[s for s in tracer.spans if s[1] in window_frames],
            trace=summary, seconds=seconds,
            cameras=traffic["cameras"], flops_per_image=arch.flops_per_image(conf))
        for m in spec.cell_metrics(bench, name, "per_layer"):
            v = spec.metric_reader(m["name"], here)(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary:
            lo, hi = summary["window"]
            dev_extra = dict(busy_s=summary["busy"], window_s=hi - lo)
            breakdown = tracer.breakdown(summary)
            log(f"traced slice: {summary['frames']} frames, {summary['launches']} kernel "
                f"launches bounded at {summary['bound_ms']} ms against {summary['kernel_ms']} "
                f"device ms; busy {summary['busy']} s of {hi - lo} s")
        tracer.uninstall()
        tracer.prof = None
    attempted = len(in_window)
    failed = driver.skipped_frames
    if undo is not None:
        undo()

    # the comparison, once the program's pipeline is freed
    kept = ([recorder.first] if recorder.first is not None else []) + \
        sorted(recorder.kept, key=lambda k: k.frame)
    recorder.driver = None
    del driver, pipe
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_pipeline(arch, conf, scene.cameras(), device, weights)
    extra = arch.ExtraNumbers() if hasattr(arch, "ExtraNumbers") else None
    numbers = check.compare(kept, source.frame, ref, extra)
    del ref
    log(f"reference: {len(kept)} frames ({[k.frame for k in kept]}) in "
        f"{time.perf_counter() - t_ref} s")
    limits = cell["check"]["limits"]
    log("not compared: " + ", ".join(f"{k} {v}" for k, v in numbers.items() if k not in limits))
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    correct = bool(limits) and len(kept) > 1 and all(
        v["value"] is not None and v["value"] <= v["limit"] for v in checks.values())
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                       count=1, memory_peak_bytes=int(peak), **dev_extra)
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    few_threads()
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    import torch

    from bench_port import spec

    torch.set_num_threads(1)
    chips = next((w["chips"] for w in spec.benchmark(ROOT)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    result, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {', '.join(bad)}")
        return 4
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
