"""The traced run's instruments, all from the benchmark's own files.

* Host spans: the step is handed a `stage` context (the program's hook
  around each of its five `timings.csv` groups) that records a host span
  and opens a `torch.profiler.record_function` range. It never
  synchronizes, so the step runs as in the untraced run.
* A profiler slice: `torch.profiler` over a fixed number of steady frames
  stepped right after the window closes, by the same driver and state.
  Stopping the profiler costs seconds of host time, which inside the window
  would read as a stall of the step.
* Kernel calls: over the same frames, each kernel wrapper of the program
  that a file `bounds/<wrapper>.py` names records its arguments and whether
  it launched (its `LAUNCHES` counters moved), so that `roofline` can bound
  each launch. A wrapper whose module or function the program lacks is
  skipped.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

from bench_port import roofline, spec, stats


class Tracer:
    def __init__(self, pipeline, here: str = spec.HERE):
        import torch

        self.torch = torch
        self.pipeline = pipeline
        self.here = here
        self.spans: List[Tuple[str, int, float, float]] = []  # (stage, frame, t0, t1)
        self.calls: List[Tuple[str, tuple, dict]] = []
        self.bounds: List[float] = []  # the bound (ms) of each recorded call
        self.frame = -1
        self.prof = None
        self.prof_frames = 0
        self._recording = False
        self._saved = []

    # -- the step, with spans ---------------------------------------------

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(name):
            yield
        self.spans.append((name, self.frame, t0, time.perf_counter()))

    def install(self) -> None:
        """Hand the pipeline's step the spans, before its first frame: the
        driver steps every frame once, in order, so the steps count the
        global frame index."""
        cls_step = type(self.pipeline).step
        pipe = self.pipeline

        def step(state, rgb, depth, calib, stage=None):
            self.frame += 1
            return cls_step(pipe, state, rgb, depth, calib, stage=self.stage)

        pipe.step = step
        self._wrap_kernels()

    def profile(self, run) -> None:
        """`run()` (the driver over the slice's frames) under the profiler,
        with the kernel calls recorded."""
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        first = self.frame
        self._recording = True
        self.prof.start()
        try:
            run()
            if self.torch.cuda.is_available():
                self.torch.cuda.synchronize()
        finally:
            self.prof.stop()
            self._recording = False
        self.prof_frames = self.frame - first
        self.bounds = [roofline.call_bound(n, a, k, self.here)["bound_ms"]
                       for n, a, k in self.calls]

    # -- kernel calls -----------------------------------------------------

    def _wrap_kernels(self) -> None:
        import importlib

        from rt3d_torch import kernels

        for name, b in roofline.kernel_bounds(self.here).items():
            try:
                mod = importlib.import_module(b.MODULE)
            except ModuleNotFoundError:
                continue
            fn = getattr(mod, b.FUNCTION, None)
            if fn is None:
                continue

            def rec(*args, _fn=fn, _name=name, **kwargs):
                if not self._recording:
                    return _fn(*args, **kwargs)
                before = sum(kernels.LAUNCHES.values())
                out = _fn(*args, **kwargs)
                if sum(kernels.LAUNCHES.values()) > before:
                    self.calls.append((_name, args, kwargs))
                return out

            setattr(mod, b.FUNCTION, rec)
            self._saved.append((mod, b.FUNCTION, fn))

    def uninstall(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []
        self.pipeline.__dict__.pop("step", None)

    # -- reading the trace ------------------------------------------------

    def summary(self, stage_names) -> Dict:
        """The profiled slice: device intervals (kernels, copies, sets) in
        seconds on the profiler's clock, the traced window, the kernels'
        time by name, and the host stage ranges."""
        if self.prof is None:
            return {}
        device, ops, host, all_t = [], {}, [], []
        for e in self.prof.events():
            tr = e.time_range
            a, b = tr.start * 1e-6, tr.end * 1e-6
            is_dev = e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
            if is_dev:
                device.append((a, b))
                ops[e.name] = ops.get(e.name, 0.0) + (b - a)
                all_t.extend((a, b))
            elif e.device_type.name == "CPU":
                all_t.extend((a, b))
                if e.name in stage_names:
                    host.append((e.name, a, b))
        if not device:
            return {}
        lo, hi = min(all_t), max(all_t)
        kernel_s = sum(s for n, s in ops.items() if roofline.is_kernel(n, self.here))
        return dict(device=device, window=(lo, hi), busy=stats.busy(device, lo, hi),
                    ops=ops, host=host, frames=self.prof_frames,
                    launches=len(self.calls), bound_ms=sum(self.bounds), kernel_ms=kernel_s * 1e3)

    @staticmethod
    def breakdown(summary: Dict, top: int = 10) -> Dict:
        """The device operations with the most time, and the longest idle
        gaps, each labelled by the host stage range open at its middle."""
        ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:top]
        lo, hi = summary["window"]
        gaps = sorted(stats.gaps(summary["device"], lo, hi), key=lambda g: g[0] - g[1])[:top]

        def label(a, b):
            mid = (a + b) / 2
            for name, s, e in summary["host"]:
                if s <= mid <= e:
                    return name
            return "between stages (driver, host)"

        return dict(device_ops=[[n, s] for n, s in ops],
                    idle_gaps=[[label(a, b), b - a] for a, b in gaps])
